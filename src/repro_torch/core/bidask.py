"""Moved to ``repro_torch.control.bidask`` (the backend-agnostic control
plane); this module keeps the reference's import path
``core.bidask`` working."""
from repro_torch.control.bidask import (KEEP_EARLIEST,  # noqa: F401
                                        OVERLOAD_FACTOR,
                                        STARVATION_THRESHOLD, Bid,
                                        MigRequest, ReceiverState,
                                        SenderState, is_overloaded,
                                        select_receiver)
