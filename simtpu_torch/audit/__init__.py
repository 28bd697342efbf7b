"""The independent placement auditor (`checker`) and the mutation helpers
that corrupt a placement in each constraint class (`fuzz`)."""
