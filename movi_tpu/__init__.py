"""movi_tpu: a pangenome full-text query engine on JAX, run on GPUs.

Implements the capabilities of Movi (the move data structure over the
run-length BWT: PML/ZML/count/kmer/MEM queries and read classification),
re-architected for an accelerator: the index is a structure-of-arrays
resident in device memory and queries run as batched gather-scans over
thousands of reads in lockstep under jax.jit / shard_map.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy to avoid importing jax at package import time
    if name in ("Index", "build_index"):
        from .api import Index, build_index

        return {"Index": Index, "build_index": build_index}[name]
    raise AttributeError(name)
