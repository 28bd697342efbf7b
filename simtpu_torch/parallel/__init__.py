"""The batched capacity sweep (`parallel/sweep.py`)."""
