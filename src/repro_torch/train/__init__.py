"""Training support (PyTorch port).  So far the checkpoint layout
(:mod:`repro_torch.train.checkpoint`) that the search checkpointer writes;
the JAX package's sparsity-aware trainer belongs to the training slice."""
