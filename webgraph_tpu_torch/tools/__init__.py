"""Command-line tools of the port: the speed test."""
