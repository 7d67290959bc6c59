"""Signal processing: STFT and Griffin-Lim."""
