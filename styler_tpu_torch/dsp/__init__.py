"""Signal processing of the port: mel front end, f0 tracking, features."""
