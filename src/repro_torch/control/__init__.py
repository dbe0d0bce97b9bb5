"""The port's copy of the backend-agnostic CascadeInfer control plane
(paper §3–§5): length routing, growth-triggered handover with bid-ask
negotiation, intra-stage rebalancing, boundary refinement and §5 flow
control, driven through :class:`~repro_torch.control.protocol.InstanceView`
and :class:`~repro_torch.control.protocol.ClusterOps` by
:class:`repro_torch.serving.server.MILSServer` over torch engines.
"""
from repro_torch.control.bidask import (Bid, MigRequest,  # noqa: F401
                                        ReceiverState, SenderState,
                                        is_overloaded, select_receiver)
from repro_torch.control.faults import (HEALTH_ALIVE,  # noqa: F401
                                        HEALTH_DEAD, HEALTH_SUSPECT,
                                        BackoffPolicy)
from repro_torch.control.plane import (ControlConfig,  # noqa: F401
                                       ControlPlane, StageState)
from repro_torch.control.protocol import (MIG_COMPLETED,  # noqa: F401
                                          MIG_FAILED, MIG_STARTED,
                                          ClusterOps, InstanceView, ReqView)
from repro_torch.control.refinement import (BoundaryRefiner,  # noqa: F401
                                            memory_based_split,
                                            quantity_based_split)
