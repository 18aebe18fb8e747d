"""Data layer of the port. Host JPEG decode and the batch loader are not
ported yet; serving starts from a uint8 batch."""
