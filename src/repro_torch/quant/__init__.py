"""Quantization codecs: packed weight schemes, packed KV-cache storage and
the precision policy (torch twins of ``repro.quant``)."""
