"""Training on the port (port of ``repro.train``): the synthetic corpus
(``data``), AdamW (``optimizer``), the autograd train step (``train_step``),
atomic checkpoints in the JAX package's format (``checkpoint``) and the
resuming loop (``loop``)."""
