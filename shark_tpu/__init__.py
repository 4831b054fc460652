"""shark-tpu: mapping-free gene separation for RNA-Seq reads on the GPU.

A ground-up JAX/XLA/Pallas re-design of the capabilities of AlgoLab/shark
(reference: /root/reference, Denti et al., Bioinformatics 2020): index a set
of gene sequences as a k-mer Bloom filter with a k-mer -> gene-ID association
table, then stream FASTQ samples through the index and report, per read, the
gene(s) it most plausibly originates from.

Architecture (accelerator-first, not a port):
  - the index is a set of dense device arrays (bit-vector, per-word popcount
    rank, CSR association table) instead of succinct rank/select structures;
  - the per-read classification is one jit'd batched function: rolling
    canonical k-mers in uint32 limb pairs, bit-exact XXH64, gathers into the
    Bloom bit-vector, and a sort-based segmented coverage reduction (the
    reference's sequential coverage recurrence is provably equal to a
    union-of-k-length-intervals, which is order-free and vectorizes);
  - scaling is jax.sharding over a device mesh: replicated-index data
    parallelism, or a sharded Bloom filter with all-to-all probe routing
    when the index exceeds one device's memory.
"""

from shark_tpu.config import SharkConfig
from shark_tpu.index.structure import SharkIndex
from shark_tpu.pipeline import load_or_build_index, run_pipeline

__version__ = "0.1.0"

__all__ = [
    "SharkConfig",
    "SharkIndex",
    "load_or_build_index",
    "run_pipeline",
    "__version__",
]
