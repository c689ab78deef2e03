"""The V-PCC decoder."""
