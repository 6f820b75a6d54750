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
between the packages: the shared state is the `Config`/`Geometry` object
(the same class, imported from the JAX package's JAX-free `config`
module) and the padded images, which callers build with numpy and hand
to either package.  The JAX-free modules of the JAX package (`config`,
`oracle/reference.py`, `data/synthetic.py`, `utils/metrics.py`) are
imported, not copied; this package never imports `jax`.
"""

from deepmatching_stereo_matching_tpu.config import Config, Geometry

__all__ = ["Config", "Geometry"]
__version__ = "0.1.0"
