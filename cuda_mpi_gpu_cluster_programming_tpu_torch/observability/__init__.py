"""Device specs for roofline bounds."""
