"""Host utilities: recording, run-folder HTML, kernel builds, devices."""
