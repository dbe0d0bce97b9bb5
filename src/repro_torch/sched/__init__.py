"""The port's copy of the SLO service classes."""
from repro_torch.sched.slo import (DEFAULT_CLASS, SLO_CLASSES,  # noqa: F401
                                  SLOSpec, assign_classes,
                                  parse_class_mix, priority_of, slo_of)
