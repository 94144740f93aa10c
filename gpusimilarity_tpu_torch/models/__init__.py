"""The search engine (FingerprintDB), the database registry and results."""
