"""Model serialization (native latin-1 dialect)."""
