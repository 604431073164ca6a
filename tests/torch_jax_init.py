"""Test helpers that make the JAX references of the port's tests cheaper to
compile; the JAX package itself is not changed.

`jit_o0(fun)` is `jax.jit` with XLA's CPU backend at optimisation level 0.
The tests compute most JAX references once, and their compile is most of
their time: at level 0 it takes about half as long. The values move by
rounding only, far inside the tests' bars.
It is not used where a reference runs long (the RANSAC cores) or where a
discrete decision follows the last bits (bundle adjustment's LM steps,
SIFT's top-k).

`jitted_pipeline_init()` runs the JAX two-view pipeline's `init` under
`jit_o0`. The JAX eval pipelines initialise their model on the first batch
by calling flax's `init` outside of jit (gluefactory_tpu/eval/export_helper.py),
which compiles every op of the model on its own: about 30 s of a pipeline's
run on the CPU. Under jit it is one compile, and it draws the same variables
from the same key.
"""

import contextlib
import functools

import flax
import jax
import pytest

from gluefactory_tpu.models.two_view_pipeline import TwoViewPipeline


O0 = {"xla_backend_optimization_level": 0}


def jit_o0(fun, **kwargs):
    return jax.jit(fun, compiler_options=O0, **kwargs)


def _jit_init(self, *args, **kwargs):
    return jit_o0(functools.partial(flax.linen.Module.init, self))(*args, **kwargs)


@contextlib.contextmanager
def jitted_pipeline_init():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TwoViewPipeline, "init", _jit_init)
        yield
