"""Host-side data helpers of the port: image decode and P-K sampling."""
