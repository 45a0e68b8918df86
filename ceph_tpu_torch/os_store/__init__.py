"""Object-store pieces of the port (device-resident shard bodies)."""
