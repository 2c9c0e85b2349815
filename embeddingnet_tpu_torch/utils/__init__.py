"""Host-side utilities of the port: metrics logging, the TensorBoard event
writer and the history plots."""
