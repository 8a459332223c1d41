"""Deploy: the exported serving artifact (``export``), weight-only int8
quantization and fake-quant (``quantize``), pruning (``prune``)."""
