"""Data parallelism: the serving mesh, and training over
``torch.distributed`` (``mesh.py``)."""
