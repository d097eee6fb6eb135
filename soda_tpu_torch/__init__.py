"""soda_tpu_torch: the `.soda` stencil compiler on PyTorch and CUDA.

The counterpart of `soda_tpu` for an NVIDIA Hopper GPU.  It keeps its own
copies of the framework-free parts of `soda_tpu` (IR, evaluator, NumPy
oracle, the golden runner's expression printer, span arithmetic, test
helpers), held equal to the originals by the tests, and adds a lark-free
parser, a torch array namespace for the evaluator, a full-grid plain
PyTorch path, a shared-memory planner and hand-written CUDA line-buffer
kernels for ranks 3 and 2.

The package imports `torch` and numpy, never `jax`, `lark` or `soda_tpu`.
Its entry points run on the card unless asked for the CPU.
"""
