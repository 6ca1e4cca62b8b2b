"""Data-parallel training over ``torch.distributed`` (NCCL on the card, gloo on the
CPU): the process group and the env-axis layout (``mesh``) and the scaling
measurement (``scaling``)."""
