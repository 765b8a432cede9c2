"""The benchmark's frozen copies of the port's numpy spec tables, MAC frame
builders and golden transmitter: the traffic generator's only source of
waveforms, kept apart from the program it measures."""
