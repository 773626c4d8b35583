"""Embedders: PCA (``pca``) and the feature scaler (``autoencoder``)."""
