"""Host data helpers of the port."""
