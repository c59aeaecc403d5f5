"""Data-parallel frame sharding over devices (shard) and the multi-process
frame-range splice and corpus runner (multihost).

Port of flac_tpu/parallel/.
"""
