"""PyTorch/CUDA port of gluefactory_tpu: SuperPoint-open + LightGlue
inference, with hand-written Hopper kernels for the LightGlue blocks and the
log assignment (csrc/). Imports torch and numpy only."""
