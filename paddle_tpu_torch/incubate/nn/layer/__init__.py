"""The fused layers (``fused_transformer``)."""
