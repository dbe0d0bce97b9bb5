"""The port's copies of the SLO service classes, the deadline- and
size-aware waiting-queue order and the park-vs-recompute policy."""
from repro_torch.sched.policy import (PARK_RESTORE_COST_S,  # noqa: F401
                                      park_or_recompute)
from repro_torch.sched.slo import (DEFAULT_CLASS, SLO_CLASSES,  # noqa: F401
                                   SLOSpec, aging_promotion,
                                   assign_classes, insert_sorted,
                                   parse_class_mix, priority_of, queue_key,
                                   slo_of, tpot_hopeless)
