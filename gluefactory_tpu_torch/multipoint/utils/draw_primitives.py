"""The synthetic-shape primitives under the reference's module path
(counterpart of gluefactory_tpu/multipoint/utils/draw_primitives.py): they
live with the dataset, multipoint/datasets/synthetic_shapes.py, and take an
explicit np.random.RandomState as their first argument."""

from ..datasets.synthetic_shapes import (  # noqa: F401
    PRIMITIVES,
    draw_checkerboard,
    draw_cube,
    draw_ellipses,
    draw_lines,
    draw_multiple_polygons,
    draw_polygon,
    draw_star,
    draw_stripes,
    gaussian_noise,
    generate_background,
)

__all__ = ["PRIMITIVES", "generate_background", "draw_lines", "draw_polygon",
           "draw_multiple_polygons", "draw_ellipses", "draw_star", "draw_checkerboard",
           "draw_stripes", "draw_cube", "gaussian_noise"]
