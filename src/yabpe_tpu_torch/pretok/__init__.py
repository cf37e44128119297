"""Host-side pre-tokenization: chunking and ingestion."""
