"""The dense decoder in PyTorch: layers, period stack, model facade."""
