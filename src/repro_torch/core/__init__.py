"""Analytical model, floorline, workload metrics and the §VI-B partitioner
(PyTorch port)."""
