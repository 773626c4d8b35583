"""All-pairs DTW scheduling over the device (``pair_scheduler``)."""
