"""Serving: the Retriever API, engines and index artifacts."""
