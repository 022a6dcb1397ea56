"""The benchmark's frozen yardstick: operation and byte counts and peaks."""
