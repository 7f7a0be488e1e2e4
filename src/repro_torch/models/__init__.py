"""Dense decoder, model API and serving state of the port."""
