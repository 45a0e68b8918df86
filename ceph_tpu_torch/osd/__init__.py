"""OSD-side helpers of the port (stripe bookkeeping)."""
