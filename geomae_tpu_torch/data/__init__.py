"""Host-side data preparation (numpy)."""
