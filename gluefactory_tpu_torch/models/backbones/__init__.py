"""Backbones of the port (`get_model("backbones.dinov2")`)."""
