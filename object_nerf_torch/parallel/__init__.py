"""Data parallelism over a `torch.distributed` process group (`mesh.py`) and
its dry run (`dryrun.py`)."""
