"""Per-dataset adapters of the question and feature preprocessing."""
