"""PyTorch/CUDA port of the DeepMatching stereo engine.

The package mirrors `deepmatching_stereo_matching_tpu` module by module:
plain tensor code is PyTorch, and each Pallas kernel of the JAX package
becomes a CUDA C++ kernel written for Hopper (`csrc/`), built with nvcc
at first use (`ops/_build.py`) and launched through `ctypes`.  Every
kernel has a plain PyTorch version beside it; a wrapper runs that plain
version only for tensors on the CPU, and launches the kernel (or
raises) for tensors on a CUDA device.

Routes (`ops/_dispatch.py`):
  * 'fused' — one image->disparity kernel per pair-direction
    (ops/fused_cuda.py; patch pixels or grad_hist (magnitude, bin)
    planes); where its tile does not fit a block (large D), the
    image->cost-volume kernel and the level-aggregation kernel
    (ops/pyramid_cuda.py); else 'exact';
  * 'exact' — descriptors in torch, then the cost-volume kernel
    (ops/costvol_cuda.py) and the pyramid + backtracking kernel
    (ops/pyramid_cuda.py), or the level-aggregation kernel for large D;
  * 'torch' — stock torch ops only, the counterpart of the JAX 'jnp' path.

The sharded strategies (`parallel/`: tiled, dslab, ringd, wtiled) run on
torch.distributed, one process per rank: NCCL on CUDA, gloo on the CPU.
Their slab and merge volumes come from the row-layout form of the
cost-volume kernel (ops/costvol_cuda.py:cost_volume_rows).

The system has no learned parameters, so there are no weights to convert
between the packages: the shared state is the configuration and the
padded images, which callers build with numpy and hand to either
package.  The port carries its own copies of the JAX package's JAX-free
modules (`config`, `oracle/reference.py`, `data/synthetic.py`, `io/`,
`native/`, `utils/metrics.py`, `utils/logging.py`) and imports nothing
of the JAX package, nor `jax`; `config.carry_over` turns the JAX
package's `Config` into this package's.
"""

from .config import Config, Geometry, carry_over

__all__ = ["Config", "Geometry", "carry_over"]
__version__ = "0.1.0"
