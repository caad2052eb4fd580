"""Host-side helpers of the port: the device an entry point defaults to."""
