"""Multi-process training and decoding of the PyTorch port over
torch.distributed (counterpart of jukebox_tpu/parallel/): the process group
and the 2-D ("dp", "mp") mesh (dist.py), the placement rules of each
parameter (shardings.py) and the placements themselves: Megatron splits of
the transformers over "mp" and ZeRO-3 shards over "dp" (placement.py)."""
