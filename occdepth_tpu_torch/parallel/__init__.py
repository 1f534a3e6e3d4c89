"""Data parallelism over processes (`ddp.py`): torchrun, the process group,
DistributedDataParallel and each rank's rows of a global batch."""
