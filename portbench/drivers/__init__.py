"""The general generators of the traffic mixes, one module a driver."""
