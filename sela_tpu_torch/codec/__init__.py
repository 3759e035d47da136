"""Host orchestration and the device decode step."""
