"""Device selection and the single-GPU bitplane store and search."""
