"""Wire codecs and the compressed exchange of the port (`repro.comm`)."""
