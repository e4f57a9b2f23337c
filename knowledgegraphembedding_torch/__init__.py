"""PyTorch/CUDA port of the knowledge-graph-embedding framework.

The package mirrors ``knowledgegraphembedding_tpu`` module for module: the
same config surface, dataset IO, synthetic generators, filter sets, the five
scorers, filtered-ranking evaluation, checkpoint layout and CLI flags. Plain
tensor code is PyTorch; the fused filtered-rank kernel is a hand-written
CUDA kernel for Hopper (``csrc/rank_counts.cu``, bound in
``ops/rank_kernel.py``). Entry points run on CUDA unless the caller asks for
the CPU.
"""

__version__ = "0.1.0"

from .config import MODEL_NAMES, ModelSpec, RunConfig  # noqa: F401
