"""Distributed pieces of the port: the int8-compressed gradient mean with
error feedback (:mod:`repro_torch.distributed.collectives`), for one data-
parallel replica."""
