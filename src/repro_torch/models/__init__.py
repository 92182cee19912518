"""Model specification IR and the LM executor."""
