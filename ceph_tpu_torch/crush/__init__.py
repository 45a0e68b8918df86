"""CRUSH data model of the port: so far the rule opcodes and the rule
types that lrc's ``crush-steps`` build (the CRUSH slice extends it)."""
