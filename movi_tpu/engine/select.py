"""Automatic engine selection: pick the speed layout when it fits the
device's memory.

The engine ladder (docs/PERF.md) trades memory for gathered rows per
base: the paired PML records cost 16*(sigma+1)^2 B/run (400 B/run for
DNA) and the paired search records 48*sigma^2 B/run (768 B/run), vs
40 B/run for the one-step fused layout.  The reference auto-dispatches
on the index mode byte (movi_launcher.cpp:408-434); here the dispatch is
on CAPACITY: use the paired layout when its table fits a budgeted
fraction of device memory and the packed run-id width, else fall back
to the one-step engine.
"""

from __future__ import annotations

import os
from typing import Optional

# leave room for the one-step records (compose input), read batches,
# color tables, and XLA scratch
BUDGET_FRACTION = 0.5


def device_memory_budget() -> int:
    """Device memory in bytes that the engines may plan with.

    MOVI_TPU_HBM_BYTES overrides it (tests and capacity planning).  On a
    GPU it is the allocator's `bytes_limit`; on the CPU the host's
    physical memory.  Any other device, or a GPU that reports no limit,
    is an error: the budget is never assumed."""
    env = os.environ.get("MOVI_TPU_HBM_BYTES")
    if env:
        return int(env)
    import jax

    dev = jax.devices()[0]
    if dev.platform == "gpu":
        limit = (dev.memory_stats() or {}).get("bytes_limit")
        if not limit:
            raise RuntimeError(f"{dev.device_kind} reports no memory limit")
        return int(limit)
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise RuntimeError(f"no memory budget rule for device platform "
                       f"{dev.platform!r}")


def paired_pml_table_bytes(r: int, sigma: int) -> int:
    return 16 * (sigma + 1) ** 2 * r


def paired_search_table_bytes(r: int, sigma: int) -> int:
    return 2 * 24 * sigma * sigma * r


def use_paired_pml(r: int, sigma: int,
                   force: Optional[bool] = None) -> bool:
    """True when PML should run on the paired two-base records."""
    from .fused2 import MAX_RUNS

    if force is not None:
        return force
    return (r < MAX_RUNS and paired_pml_table_bytes(r, sigma)
            <= BUDGET_FRACTION * device_memory_budget())


def use_paired_color(r: int, sigma: int, num_sets: int,
                     force: Optional[bool] = None) -> bool:
    """True when Movi Color should run on the paired 32 B records
    (which additionally require the kept-set count to fit 16 bits)."""
    from .fused2 import MAX_RUNS

    if force is not None:
        return force and num_sets + 1 <= 0xFFFF
    return (r < MAX_RUNS and num_sets + 1 <= 0xFFFF
            and 2 * paired_pml_table_bytes(r, sigma)
            <= BUDGET_FRACTION * device_memory_budget())


def use_paired_search(r: int, sigma: int,
                      force: Optional[bool] = None) -> bool:
    """True when count/ZML should run on the paired search records."""
    from .fused_search2 import MAX_RUNS

    if force is not None:
        return force
    return (r < MAX_RUNS and sigma + 2 <= 8
            and paired_search_table_bytes(r, sigma)
            <= BUDGET_FRACTION * device_memory_budget())


def one_step_pml_table_bytes(r: int, sigma: int) -> int:
    return 8 * (sigma + 1) * r


def one_step_search_table_bytes(r: int, sigma: int) -> int:
    return 32 * sigma * r


def pick_backend(r: int, sigma: int, kind: str = "pml",
                 model_shards: int = 1,
                 force_paired: Optional[bool] = None) -> str:
    """Full engine ladder selection: 'paired' when the two-step layout
    fits, else 'one-step', else -- when the one-step table itself
    exceeds the budget and a model mesh axis is available -- 'sharded'
    (parallel/sharded_index.py: table split over model_shards cards,
    capacity x shards), else the 'compact' fallback."""
    one_step = (one_step_pml_table_bytes if kind == "pml"
                else one_step_search_table_bytes)(r, sigma)
    paired = (use_paired_pml if kind == "pml"
              else use_paired_search)(r, sigma, force=force_paired)
    if paired:
        return "paired"
    budget = BUDGET_FRACTION * device_memory_budget()
    if one_step <= budget:
        return "one-step"
    if model_shards > 1 and one_step <= budget * model_shards:
        return "sharded"
    return "compact"
