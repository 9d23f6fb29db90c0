"""RECIPE core on the port: the simulated PM domain, the conversion
framework with its snapshot/epoch protocol, RECIPE's five converted
indexes (P-CLHT, P-ART, P-HOT, P-Masstree, P-BwTree) on the segmented
PM arena, the plan scheduler, the YCSB generator and the targeted crash
testing (the per-store sweep, the durability audit and the
batched-plan sweep).  The three hand-crafted PM baselines (CCEH, FAST&FAIR,
Level hashing) are in ``core.baselines``."""

from .pmem import (CACHELINE_BYTES, WORD_BYTES, WORDS_PER_LINE, CrashPoint,
                   DeadlockError, NULL, OpCounters, PMem, Region,
                   count_stores, measure_op)
from .conditions import (CONVERSION_TABLE, PROBE_STAT_KEYS, Condition,
                         ConversionSpec, IndexSnapshot, RecipeIndex,
                         crash_detect_fix, register)
from .plan import (Op, OpKind, Plan, PlanResult, Wave, run_plan,
                   schedule_waves, split_by_shard)
from .arena import Arena
from .clht import PCLHT
from .art import PART
from .hot import PHOT
from .bwtree import PBwTree
from .masstree import PMasstree
from .crash_testing import (CrashReport, PMSnapshot, audit_durability,
                            group_commit_boundaries, plan_crash_sweep,
                            plan_prefix_states, run_crash_sweep,
                            validation_points)

__all__ = [
    "CACHELINE_BYTES", "WORD_BYTES", "WORDS_PER_LINE", "CrashPoint",
    "DeadlockError", "NULL", "OpCounters", "PMem", "Region", "count_stores",
    "measure_op",
    "CONVERSION_TABLE", "PROBE_STAT_KEYS", "Condition", "ConversionSpec",
    "IndexSnapshot", "RecipeIndex", "crash_detect_fix", "register",
    "Op", "OpKind", "Plan", "PlanResult", "Wave", "run_plan",
    "schedule_waves", "split_by_shard", "Arena", "PCLHT", "PART", "PHOT", "PMasstree",
    "PBwTree", "CrashReport", "PMSnapshot", "audit_durability",
    "group_commit_boundaries", "plan_crash_sweep", "plan_prefix_states",
    "run_crash_sweep", "validation_points",
]
