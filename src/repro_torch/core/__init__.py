"""Host-side planning and the single-device DP engine of the port."""
