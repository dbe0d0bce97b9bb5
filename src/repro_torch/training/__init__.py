"""Training on one device: AdamW, the synthetic token stream, ``.npz``
checkpoints and the train loop (the port of ``repro.training``)."""
