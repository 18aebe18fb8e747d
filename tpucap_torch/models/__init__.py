"""Models of the port: layers, the ResNet-50 and ViT encoders and the
merge LSTM decoder."""
