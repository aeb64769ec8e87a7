"""Measurement tools run by hand on the card; neither the service, the
trainer nor the tests call them."""
