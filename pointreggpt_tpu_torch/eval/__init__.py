"""FID: the InceptionV3 feature extractor and the Fréchet distance."""
