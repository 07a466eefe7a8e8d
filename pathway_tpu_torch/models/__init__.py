"""Encoder models of the port: tokenizer, batching, TextEncoder, SentenceEncoder."""
