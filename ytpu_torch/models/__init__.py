"""Batched doc state layout and the chunked replay driver."""
