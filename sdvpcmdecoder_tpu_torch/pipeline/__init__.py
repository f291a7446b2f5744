"""Host orchestration: the STC-007 decode chain, the round geometry and
state, audio chain, WAV writer."""
