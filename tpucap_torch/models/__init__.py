"""Models of the port: layers, the ResNet-50 encoder and the merge LSTM
decoder."""
