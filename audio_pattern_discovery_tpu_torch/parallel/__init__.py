"""Multi-device execution over a list of devices: the mesh and placement
descriptors (``mesh``), all-pairs DTW scheduling (``pair_scheduler``) and
the sharded long-pair wavefront (``wavefront``)."""
