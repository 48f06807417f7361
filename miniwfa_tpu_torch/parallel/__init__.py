"""Multi-device alignment: a batch's lanes split over a 1-D mesh of
devices, one thread per card within a process and ``torch.distributed``
(gloo) across processes (the port of ``miniwfa_tpu/parallel/``)."""
