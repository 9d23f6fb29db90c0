"""RECIPE core on the port: the simulated PM domain, the conversion
framework with its snapshot/epoch protocol, RECIPE's five converted
indexes (P-CLHT, P-ART, P-HOT, P-Masstree, P-BwTree) on the segmented
PM arena, the plan scheduler, the YCSB generator and the batched-plan
crash sweep.  The three hand-crafted baselines of the JAX package are
not ported yet."""

from .pmem import (CACHELINE_BYTES, WORD_BYTES, WORDS_PER_LINE, CrashPoint,
                   DeadlockError, NULL, OpCounters, PMem, Region)
from .conditions import (CONVERSION_TABLE, PROBE_STAT_KEYS, Condition,
                         ConversionSpec, IndexSnapshot, RecipeIndex,
                         crash_detect_fix, register)
from .plan import Op, OpKind, Plan, PlanResult, Wave, run_plan, schedule_waves
from .arena import Arena
from .clht import PCLHT
from .art import PART
from .hot import PHOT
from .bwtree import PBwTree
from .masstree import PMasstree
from .crash_testing import (CrashReport, PMSnapshot, group_commit_boundaries,
                            plan_crash_sweep, plan_prefix_states,
                            validation_points)

__all__ = [
    "CACHELINE_BYTES", "WORD_BYTES", "WORDS_PER_LINE", "CrashPoint",
    "DeadlockError", "NULL", "OpCounters", "PMem", "Region",
    "CONVERSION_TABLE", "PROBE_STAT_KEYS", "Condition", "ConversionSpec",
    "IndexSnapshot", "RecipeIndex", "crash_detect_fix", "register",
    "Op", "OpKind", "Plan", "PlanResult", "Wave", "run_plan",
    "schedule_waves", "Arena", "PCLHT", "PART", "PHOT", "PMasstree",
    "PBwTree", "CrashReport", "PMSnapshot",
    "group_commit_boundaries", "plan_crash_sweep", "plan_prefix_states",
    "validation_points",
]
