"""Host-side OLAF core (numpy copies of ``repro.core``) and the torch queue."""
