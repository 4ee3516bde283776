"""Model code of the port: the decoders and the MLP classifiers."""
