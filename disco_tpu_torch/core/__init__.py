"""Signal-processing core of the port: math helpers, STFT/ISTFT, masks."""
