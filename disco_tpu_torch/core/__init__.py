"""Signal-processing core of the port: math helpers, STFT/ISTFT, masks, and
the host float64 evaluation metrics (``metrics``, ``bss``, ``sigproc``)."""
