"""Data layer of the port: host JPEG decode and normalization
(``preprocess``) and the prefetching batch loader (``pipeline``)."""
