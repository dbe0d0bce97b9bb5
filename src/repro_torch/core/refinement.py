"""Moved to ``repro_torch.control.refinement`` (the backend-agnostic
control plane); this module keeps the reference's import path
``core.refinement`` working."""
from repro_torch.control.refinement import (BoundaryRefiner,  # noqa: F401
                                            divide_evenly,
                                            memory_based_split,
                                            optimal_split,
                                            quantity_based_split)
