"""Parallel modules on ``torch.distributed`` (``loftr_tpu.parallel``):
collectives (``comm``), process groups and the named-axis mesh (``mesh``),
sequence-parallel attention (``seq_attention``)."""
