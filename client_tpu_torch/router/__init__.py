"""The L7 router: only the selection hash the HTTP client shares with it
(``core.rendezvous_pick``) is ported so far."""
