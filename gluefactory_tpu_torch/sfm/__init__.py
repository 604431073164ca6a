"""The SfM/SLAM layer (counterpart of gluefactory_tpu/sfm): triangulation,
Schur-complement bundle adjustment, the pose graph, ATE and incremental
SLAM, in float32 on the caller's device (CUDA unless a CPU device is
passed)."""
