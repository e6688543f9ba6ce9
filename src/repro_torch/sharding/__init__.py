"""Parameter sharding rules."""
