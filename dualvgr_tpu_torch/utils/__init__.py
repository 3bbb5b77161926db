"""Device selection and weight interchange."""
