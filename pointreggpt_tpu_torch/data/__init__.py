"""Host-side dataset helpers of the PyTorch port."""
