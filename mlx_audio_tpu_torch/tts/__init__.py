"""The TTS command-line tools and the web player of the port."""
