"""The plain reference and the input makers of the benchmark; nothing here
imports the port."""
