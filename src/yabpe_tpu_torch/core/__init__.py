"""Core data structures: vocab tables, padded words, lex keys."""
