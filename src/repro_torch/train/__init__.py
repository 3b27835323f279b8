"""Training on one device: optimizers, gradient compression, the train
step, checkpoints and the fault-tolerant loop (port of ``repro.train``)."""
