"""Numerical ops: spectrogram, segmentation, DTW (plain torch) and the
hand-written CUDA DTW kernel (``dtw_cuda``)."""
