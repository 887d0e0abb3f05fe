"""Training of the port: optimizers, the train step, checkpoints and the
fault-tolerant runner (``repro/train``'s counterparts)."""
