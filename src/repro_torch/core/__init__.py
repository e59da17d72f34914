"""Design-space engine port: hardware constants and the queueing closed form."""
