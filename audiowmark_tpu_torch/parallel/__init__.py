"""Many streams per call: the device mesh, the sharded batch embed and the
fleet batch API."""
