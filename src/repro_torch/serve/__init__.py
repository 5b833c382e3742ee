"""Batched serving: :class:`~repro_torch.serve.engine.Engine`."""
