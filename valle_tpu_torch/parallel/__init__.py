"""Data and tensor parallelism: the serving mesh and training over
``torch.distributed`` (``mesh.py``), and the 'model' axis that splits
the attention out-projections and the FFNs over shards (``tensor.py``)."""
