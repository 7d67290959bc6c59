"""Host utilities: wav files, PNG files, the metrics log."""
