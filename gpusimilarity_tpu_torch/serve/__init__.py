"""HTTP/JSON front end and request batching."""
