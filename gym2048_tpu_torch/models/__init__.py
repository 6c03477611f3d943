"""N-tuple value networks and their table lookup kernel (counterpart of
``gym2048_tpu.models``; the CNN of ``models/resnet.py`` is not ported yet)."""
